"""Static configuration of one analysis run (port of the reference's
``AnalyzerConfig``), the Kafka wire scan's three transport policies
(``TransportRetryConfig``, ``CorruptionConfig``, ``DataLossConfig``) and
the parallel-ingest sizing (``IngestConfig``), the superbatch dispatch
sizing (``DispatchConfig``) and the remote segment tier's knobs
(``SegmentFetchConfig``), the reference's, with the same validation and
error text.

Same fields, defaults and validation as the reference, restricted to what
the port runs: wire format 4 or 5, alive-pair compaction auto or off, one
device.  Asking for a mesh raises "not yet ported" instead of quietly
running something else.  The reference's two environment kill switches
hold here too: ``KTA_WIRE_V4`` resolves ``wire_format`` 0 to v4 and
``KTA_DISABLE_COMPACTION`` turns alive-pair compaction off, each with the
reason recorded at resolution (`wire_v4_reason`,
`alive_compaction_off_reason`) for the engine's fallback bookings.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TransportRetryConfig:
    """Transport-fault tolerance knobs for the live Kafka scan.

    Not part of `AnalyzerConfig`: retry pacing changes neither state
    shapes nor fold semantics.  Mapped from the librdkafka-style
    ``--librdkafka`` overrides table in io/kafka_wire.py.
    """

    #: First delay after a transport failure (librdkafka ``retry.backoff.ms``;
    #: ``reconnect.backoff.ms`` raises it too when set higher).  Doubles per
    #: consecutive failure.
    backoff_ms: int = 100
    #: Backoff ceiling (librdkafka ``reconnect.backoff.max.ms``).
    backoff_max_ms: int = 10_000
    #: Consecutive transport failures a partition survives before it is
    #: marked *degraded* (scan continues without it) instead of retrying
    #: forever.  Non-librdkafka knob: ``transport.retry.budget``.
    retry_budget: int = 8
    #: Fractional jitter applied to every delay (librdkafka applies ±20%):
    #: a delay d is drawn uniformly from [d·(1-j), d·(1+j)].
    jitter: float = 0.2

    def __post_init__(self) -> None:
        if self.backoff_ms < 1:
            raise ValueError("retry.backoff.ms must be >= 1")
        if self.backoff_max_ms < self.backoff_ms:
            raise ValueError(
                "reconnect.backoff.max.ms must be >= retry.backoff.ms"
            )
        if self.retry_budget < 1:
            raise ValueError("transport.retry.budget must be >= 1")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError("retry jitter must be in [0, 1)")

    @classmethod
    def from_overrides(cls, overrides: dict) -> "TransportRetryConfig":
        """Pop the retry-related librdkafka-style properties out of an
        overrides dict (mutating it, like the other knob parsers in
        io/kafka_wire.py) and build the config."""
        base = int(overrides.pop("retry.backoff.ms", 100))
        # librdkafka paces reconnect attempts separately; this client runs
        # one schedule, so an explicitly higher reconnect floor wins.
        base = max(base, int(overrides.pop("reconnect.backoff.ms", base)))
        return cls(
            backoff_ms=base,
            backoff_max_ms=max(
                base, int(overrides.pop("reconnect.backoff.max.ms", 10_000))
            ),
            retry_budget=int(overrides.pop("transport.retry.budget", 8)),
        )


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Single-scan parallel-ingest sizing (``--ingest-workers``).

    Like `TransportRetryConfig`, deliberately NOT part of `AnalyzerConfig`:
    how many host threads feed the device changes neither state shapes nor
    fold semantics (the fan-in merge is a pure function of the inputs), so
    it must not churn the checkpoint fingerprint.  A snapshot taken by an
    N-worker scan resumes under any other worker count.
    """

    #: ``1`` = the sequential path (the default), ``N`` = that many
    #: partition-sharded ingest workers, ``"auto"`` = size from the host:
    #: min(cores - 1, partitions), keeping one core for the merge loop and
    #: the device dispatch.
    workers: "int | str" = 1

    def __post_init__(self) -> None:
        if isinstance(self.workers, str):
            if self.workers != "auto":
                raise ValueError(
                    f"ingest workers {self.workers!r} invalid "
                    "(a positive integer, or 'auto')"
                )
        elif self.workers < 1:
            raise ValueError("ingest workers must be >= 1")

    @classmethod
    def parse(cls, text: str) -> "IngestConfig":
        """CLI spelling: a positive integer or ``auto``."""
        if text.strip().lower() == "auto":
            return cls(workers="auto")
        try:
            n = int(text)
        except ValueError:
            raise ValueError(
                f"bad --ingest-workers {text!r}: expected a positive "
                "integer or 'auto'"
            ) from None
        return cls(workers=n)

    def resolve(self, num_partitions: int) -> int:
        """Concrete worker count for a topic with ``num_partitions``
        partitions (workers beyond the partition count would sit idle —
        each partition lives in exactly one worker)."""
        if self.workers == "auto":
            # Cores this process may actually run on: in a cgroup- or
            # affinity-limited container os.cpu_count() reports the
            # host's cores, and sizing from it would oversubscribe.
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:  # non-Linux
                cores = os.cpu_count() or 1
            want = max(1, cores - 1)
        else:
            want = int(self.workers)
        return max(1, min(want, num_partitions))



@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Superbatch device-dispatch sizing (``--superbatch``/``--dispatch-depth``).

    Like `IngestConfig`, deliberately NOT part of `AnalyzerConfig`: how many
    packed batches ride one dispatch (and how many superbatches may
    be in flight) changes neither state shapes nor fold semantics — the
    superbatch fold applies the K batches in exactly the order the
    sequential path would (backends/step.py::superbatch_fold), so results
    stay byte-identical and it must not churn the checkpoint fingerprint.
    A snapshot taken by a K-superbatch scan resumes under any other K or D
    (snapshots land only at superbatch boundaries — engine.py).
    """

    #: Packed batches folded per dispatch: one throttle, one completion
    #: event and, under alive compaction, one merged pair table for K
    #: rows.  ``1`` = the one-dispatch-per-batch path;
    #: ``"auto"`` targets 2^20 records per dispatch:
    #: max(1, min(16, 2^20 // batch_size)), capped below.
    superbatch: "int | str" = 1
    #: Bound on superbatches staged/transferring while the device folds
    #: (the in-flight dispatch queue, backends/base.py::DispatchQueue).
    #: 2 = transfer of superbatch i+1 overlaps the fold of i; higher
    #: values deepen the pipeline at the cost of host+device memory for
    #: the extra staged buffers.
    depth: int = 2
    #: Guardrail on ``auto``'s fold size: at most this many records per
    #: dispatch, the reference's cap (its measurements on its own rigs
    #: found that one long synchronous fold starves the ingest overlap).
    #: At the default batch of 2^18 ``auto`` therefore resolves to K = 1.
    #: Explicit K is never capped: an operator who asks for 16 gets 16.
    auto_fold_cap_records: int = 1 << 18

    def __post_init__(self) -> None:
        if isinstance(self.superbatch, str):
            if self.superbatch != "auto":
                raise ValueError(
                    f"superbatch {self.superbatch!r} invalid "
                    "(a positive integer, or 'auto')"
                )
        elif self.superbatch < 1:
            raise ValueError("superbatch must be >= 1")
        if self.depth < 1:
            raise ValueError("dispatch depth must be >= 1")
        if self.auto_fold_cap_records < 1:
            raise ValueError("auto fold cap must be >= 1 record")

    @classmethod
    def parse(cls, superbatch: str, depth: int = 2) -> "DispatchConfig":
        """CLI spelling: ``--superbatch K|auto`` + ``--dispatch-depth D``."""
        text = superbatch.strip().lower()
        if text == "auto":
            return cls(superbatch="auto", depth=depth)
        try:
            k = int(text)
        except ValueError:
            raise ValueError(
                f"bad --superbatch {superbatch!r}: expected a positive "
                "integer or 'auto'"
            ) from None
        return cls(superbatch=k, depth=depth)

    def resolve(self, batch_size: int) -> int:
        """Concrete K for a given batch size.  ``auto`` targets 2^20
        records per dispatch, capped at 16 rows and at
        ``auto_fold_cap_records`` records per dispatch (the reference's
        rule, carried over exactly)."""
        if self.superbatch == "auto":
            k = max(1, min(16, (1 << 20) // max(1, batch_size)))
            fold_cap = max(1, self.auto_fold_cap_records // max(1, batch_size))
            return min(k, fold_cap)
        return int(self.superbatch)


@dataclasses.dataclass(frozen=True)
class SegmentFetchConfig:
    """Remote-segment-tier knobs (``--segment-readahead``/``--segment-cache``;
    io/objstore.py + io/segstore.py, DESIGN.md §21).

    Like `IngestConfig`, deliberately NOT part of `AnalyzerConfig`: how a
    chunk's bytes ARRIVE (read ahead over the network, served from a local
    cache, or memory-mapped) changes neither state shapes nor fold
    semantics — a remote scan is byte-identical to the local-directory
    scan of the same chunks — so none of it may churn the checkpoint
    fingerprint.  A snapshot taken against one store resumes against any
    other store holding the same segments (cross-store resume).
    """

    #: Chunks kept in flight ahead of each consuming ingest stream (the
    #: per-stream WINDOW; the process-wide fetch scheduler in
    #: io/fetchsched.py supplies the workers).  In-flight chunk memory
    #: stays bounded by streams × (readahead + 1) chunks.  ``"auto"``
    #: resolves per store: 0 for local directories (the memmap faults
    #: pages in for free) and 4 for remote stores (enough speculation in
    #: flight to hide tens of ms of per-GET latency behind the fused
    #: decode→pack pass).  0 disables speculation: every chunk is a
    #: demand fetch at first touch — still admitted through the
    #: scheduler.
    readahead: "int | str" = "auto"
    #: Worker count of the ONE process-wide fetch scheduler
    #: (``--fetch-concurrency N|auto``) — the single admission point for
    #: every remote byte.  Sized once per process, NOT per stream: total
    #: connection count no longer multiplies with ingest workers.
    #: ``"auto"`` sizes from the host (min(16, max(4, cpu_count))) and
    #: grows with the resolved ingest-stream count; an explicit N pins it.
    fetch_concurrency: "int | str" = "auto"
    #: Local chunk-cache directory (``--segment-cache``); None disables.
    #: Remote stores only — caching a local directory would just copy it.
    cache_dir: "str | None" = None
    #: Cache size bound in bytes (``--segment-cache-bytes``): inserts
    #: evict least-recently-used entries past it.
    cache_max_bytes: int = 1 << 30
    #: Per-request socket timeout (connect and read) in seconds.  A stall
    #: past it is a transient transport failure: backoff, retry, budget.
    timeout_s: float = 30.0
    #: Transport retry pacing + per-partition budget — the SAME recovery
    #: substrate the live wire scan runs (io/retry.py): a partition whose
    #: chunks stay unreachable past the budget is degraded, not fatal.
    retry: TransportRetryConfig = dataclasses.field(
        default_factory=TransportRetryConfig
    )

    def __post_init__(self) -> None:
        if isinstance(self.readahead, str):
            if self.readahead != "auto":
                raise ValueError(
                    f"segment readahead {self.readahead!r} invalid "
                    "(an integer >= 0, or 'auto')"
                )
        elif self.readahead < 0:
            raise ValueError("segment readahead must be >= 0")
        if isinstance(self.fetch_concurrency, str):
            if self.fetch_concurrency != "auto":
                raise ValueError(
                    f"fetch concurrency {self.fetch_concurrency!r} invalid "
                    "(an integer >= 1, or 'auto')"
                )
        elif self.fetch_concurrency < 1:
            raise ValueError("fetch concurrency must be >= 1")
        if self.cache_max_bytes < 1:
            raise ValueError("--segment-cache-bytes must be >= 1")
        if self.timeout_s <= 0:
            raise ValueError("segment fetch timeout must be > 0 seconds")

    @classmethod
    def parse(
        cls,
        readahead: str = "auto",
        cache_dir: "str | None" = None,
        cache_max_bytes: int = 1 << 30,
        fetch_concurrency: str = "auto",
    ) -> "SegmentFetchConfig":
        """CLI spelling: ``--segment-readahead N|auto``,
        ``--fetch-concurrency N|auto``, + cache flags."""
        text = str(readahead).strip().lower()
        if text == "auto":
            ra: "int | str" = "auto"
        else:
            try:
                ra = int(text)
            except ValueError:
                raise ValueError(
                    f"bad --segment-readahead {readahead!r}: expected an "
                    "integer >= 0 or 'auto'"
                ) from None
        fc_text = str(fetch_concurrency).strip().lower()
        if fc_text == "auto":
            fc: "int | str" = "auto"
        else:
            try:
                fc = int(fc_text)
            except ValueError:
                raise ValueError(
                    f"bad --fetch-concurrency {fetch_concurrency!r}: "
                    "expected an integer >= 1 or 'auto'"
                ) from None
        return cls(
            readahead=ra, cache_dir=cache_dir, cache_max_bytes=cache_max_bytes,
            fetch_concurrency=fc,
        )

    def resolve_readahead(self, remote: bool) -> int:
        """Concrete per-stream read-ahead depth: ``auto`` = 4 for remote
        stores (hide per-GET wire latency behind the running decode→pack
        pass), 0 for local directories (nothing to hide — page faults)."""
        if self.readahead == "auto":
            return 4 if remote else 0
        return int(self.readahead)

    def resolve_concurrency(self) -> "int | None":
        """Concrete scheduler pool size, or None for ``auto`` (the
        scheduler sizes itself from the host and the engine's resolved
        ingest-stream count — io/fetchsched.py)."""
        if self.fetch_concurrency == "auto":
            return None
        return int(self.fetch_concurrency)

#: Valid --on-corruption policies, in escalation order.
CORRUPTION_POLICIES = ("fail", "skip", "quarantine")


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    """Poison-frame policy for the live Kafka scan (io/kafka_wire.py).

    Like `TransportRetryConfig`, not part of `AnalyzerConfig`: how the
    scan reacts to corrupt frames changes neither state shapes nor fold
    semantics.

    Policies (applied only after a re-fetch reproduced the identical
    failure — a one-shot in-flight bit flip is retried, not classified):

    - ``fail``: abort the scan with the classified error (the default —
      exactly the pre-corruption-layer behavior);
    - ``skip``: skip exactly the poisoned frame, account for it
      per-partition, finish the scan, exit `cli.EXIT_CORRUPT`;
    - ``quarantine``: like skip, plus the raw frame bytes are spooled to
      ``quarantine_dir`` with a JSON sidecar (io/quarantine.py) so the
      evidence survives for offline analysis.
    """

    policy: str = "fail"
    quarantine_dir: "str | None" = None

    def __post_init__(self) -> None:
        if self.policy not in CORRUPTION_POLICIES:
            raise ValueError(
                f"on-corruption policy {self.policy!r} invalid "
                f"({', '.join(CORRUPTION_POLICIES)})"
            )
        if self.policy == "quarantine" and not self.quarantine_dir:
            raise ValueError(
                "--on-corruption=quarantine requires --quarantine-dir"
            )
        if self.quarantine_dir and self.policy != "quarantine":
            raise ValueError(
                "--quarantine-dir only applies with --on-corruption=quarantine"
            )


#: Valid --on-data-loss policies, in escalation order.
DATA_LOSS_POLICIES = ("fail", "report", "ignore")


@dataclasses.dataclass(frozen=True)
class DataLossConfig:
    """Log-mutation policy for the live Kafka scan (io/kafka_wire.py):
    what to do when the log MOVES under the scanner and records in
    ``[cursor, new_log_start)`` are unreachable (retention race), or a
    leader-epoch divergence proves the log was truncated below the
    cursor (unclean election).

    Like `CorruptionConfig`, not part of `AnalyzerConfig`.  Whatever the
    policy, every lost record is spanned (``KafkaWireSource.loss_stats``)
    — the policy only governs whether the scan continues and how the exit
    code reflects the loss:

    - ``fail``: abort the scan with the classified error and
      `cli.EXIT_DATA_LOSS`; with ``--snapshot-dir`` a fold-consistent
      checkpoint is written first, so a ``--resume`` continues past the
      named gap;
    - ``report``: keep scanning the surviving records, print the loss
      as a DATA-LOSS block after the report, exit 0 (the default);
    - ``ignore``: keep scanning and exit 0 with no block — for logs
      where retention churn is expected; the scan result still carries
      the loss.
    """

    policy: str = "report"

    def __post_init__(self) -> None:
        if self.policy not in DATA_LOSS_POLICIES:
            raise ValueError(
                f"on-data-loss policy {self.policy!r} invalid "
                f"({', '.join(DATA_LOSS_POLICIES)})"
            )


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
    #: (wire v5 with ``-c``, unless ``KTA_DISABLE_COMPACTION`` is set);
    #: ``off`` keeps the per-row pair sections.
    alive_compaction: str = "auto"
    #: ``0`` resolves to 5 (4 when ``KTA_WIRE_V4`` is set); ``5`` is the
    #: combiner format (per-partition tables); ``4`` ships per-record
    #: columns.
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
            # Resolved, with its reason, once here: the engine's booking
            # must describe the decision taken, not a later environment.
            forced = bool(os.environ.get("KTA_WIRE_V4"))
            object.__setattr__(self, "wire_format", 4 if forced else 5)
            object.__setattr__(
                self, "_wire_v4_reason", "env-kill-switch" if forced else None
            )
        elif self.wire_format in (4, 5):
            object.__setattr__(
                self,
                "_wire_v4_reason",
                "explicit" if self.wire_format == 4 else None,
            )
        else:
            raise ValueError(
                f"wire_format {self.wire_format!r} invalid (0=auto, 4, or 5)"
            )
        if self.alive_compaction not in ("auto", "off"):
            raise ValueError(
                f"alive_compaction {self.alive_compaction!r} invalid "
                "(auto or off)"
            )
        # The compacted pair table is a v5 combiner section; v4, "off" and
        # the kill switch keep the per-row pairs.
        compact = False
        off_reason = None
        if self.count_alive_keys:
            if self.alive_compaction == "off":
                off_reason = "explicit"
            elif os.environ.get("KTA_DISABLE_COMPACTION"):
                off_reason = "env-kill-switch"
            elif self.wire_format != 5:
                off_reason = "wire-v4"
            else:
                compact = True
        object.__setattr__(self, "_compact_alive", compact)
        object.__setattr__(self, "_alive_compaction_off_reason", off_reason)
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
    def wire_v4_reason(self) -> "str | None":
        """Why this config runs wire v4 (None under v5): ``env-kill-switch``
        (``KTA_WIRE_V4`` at construction) or ``explicit``; the engine books
        it on ``kta_wire_v4_fallback_total``."""
        return self._wire_v4_reason

    @property
    def alive_compaction_off_reason(self) -> "str | None":
        """Why an alive-key scan runs without pair compaction (None when
        it compacts or counts no alive keys): ``explicit``,
        ``env-kill-switch`` (``KTA_DISABLE_COMPACTION``) or ``wire-v4``;
        the engine books it on ``kta_alive_compaction_off_total``."""
        return self._alive_compaction_off_reason

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
